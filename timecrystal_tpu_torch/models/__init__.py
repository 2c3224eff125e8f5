"""Physical models: the Floquet kicked-Ising chain."""
