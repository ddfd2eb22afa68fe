"""PyTorch + CUDA port of marginalign_trna_tpu (marginAlign-tRNA).

The JAX package beside it is the reference; this package imports nothing
of it.  It carries its own copies of the host modules it needs (io, models
and the model files, utils, align/chain.py, stats, tools, the native host
library's bindings in native.py, the band packers in ops/band.py) and
ports the modules that run on the device: the guide Viterbi, the
forward-backward posteriors, the MEA decode, the tracebacks and
marginCaller's expectation pass run through hand-written CUDA kernels
(csrc/) on CUDA tensors and through their plain PyTorch versions on CPU
tensors.

    python -m marginalign_trna_tpu_torch marginAlign reads.fq ref.fa out.sam
    python -m marginalign_trna_tpu_torch marginCaller in.sam ref.fa out.vcf
    python -m marginalign_trna_tpu_torch marginStats in.sam reads.fq ref.fa \
        --readIdentity
"""
