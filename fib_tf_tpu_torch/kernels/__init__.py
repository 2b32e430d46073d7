"""Builder of the port's hand-written CUDA kernels (sources in csrc/)."""
