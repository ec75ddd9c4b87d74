"""Plain PyTorch references of the benchmark's architectures.  They import
nothing of ``repro_torch``, ``repro`` or JAX: each works out again, from the
seed and the inputs the benchmark hands it, what the port computes."""
