"""GF(2^8)/CRC32 math: numpy golden copies, plain PyTorch versions
(``torch_ec``) and the CUDA kernels with their wrappers (``cuda_ec``)."""
