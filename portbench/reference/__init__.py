"""The benchmark's plain reference: TEBD of the kicked-Ising chain in
plain PyTorch with LAPACK's SVD (``tebd``).  Nothing here imports the
program under test."""
