"""Time evolution: Floquet TEBD."""
