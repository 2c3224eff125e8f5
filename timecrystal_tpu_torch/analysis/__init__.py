"""Application layer: DTC detection, the phase / drive / range diagrams and
Figures A-D."""
