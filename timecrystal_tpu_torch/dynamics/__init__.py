"""Time evolution: Floquet and Suzuki-Trotter TEBD, TDVP, open systems and
imaginary-time ground states."""

from .ground_state import find_ground_state, imaginary_time_scan
from .open_system import LindbladEvolution, OpenSystemEvolution
from .tebd import (CustomFloquet, NearestNeighborModel, TEBDEvolution,
                   spin_chain_model)

__all__ = ["TEBDEvolution", "CustomFloquet", "NearestNeighborModel",
           "spin_chain_model", "find_ground_state", "imaginary_time_scan",
           "LindbladEvolution", "OpenSystemEvolution"]
