"""python -m marginalign_trna_tpu_torch marginAlign reads.fq ref.fa out.sam"""
import sys

from .cli import main

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
