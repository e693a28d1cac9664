"""Message-passing operations and the CUDA kernels they dispatch to."""
