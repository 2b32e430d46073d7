"""Numerics core of the port: grid operators, Chebyshev fits, integrators
and the CUDA substep kernel's wrapper."""
