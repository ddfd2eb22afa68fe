"""PyTorch + CUDA port of marginalign_trna_tpu (marginAlign-tRNA).

The JAX package beside it is the reference.  This package reuses its
jax-free host modules (io, models, utils, align/chain.py, native.py, the
band packers in ops/band.py) and ports the modules that run on the device:
the flat-gap forward-backward posteriors, the guide Viterbi and the MEA
decode run through hand-written CUDA kernels (csrc/) on CUDA tensors and
through their plain PyTorch versions on CPU tensors.

    python -m marginalign_trna_tpu_torch marginAlign reads.fq ref.fa out.sam
"""
