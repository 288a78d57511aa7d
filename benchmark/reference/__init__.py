"""The plain reference of the benchmark: PyTorch and NumPy only.

It imports neither JAX nor the JAX package nor anything of the program
under test (`scale_letkf_torch`): it works every compared answer out again
from the inputs the benchmark made. `model` is the split-explicit dynamical
core with Kessler warm rain, `obsop` the projection and the observation
operators, `letkf` the bucket table and the local transform at single
gridpoints.
"""
