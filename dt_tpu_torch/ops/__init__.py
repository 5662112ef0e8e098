"""Ops of the port: ``nn`` (PyTorch calls) and ``kernels`` (CUDA kernels
with their plain versions, built by ``_build``)."""
