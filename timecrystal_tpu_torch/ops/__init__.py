"""SVD for the two-site update: the Jacobi sweep kernel, its torch twin,
and the top-k front end."""
