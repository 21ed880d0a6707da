"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version (taken for tensors on the CPU):

* bit-plane pack        (bitplane.py,    csrc/bitplane_pack.cu)
* LZ4 match prep        (lz4.py,         csrc/lz4_prep.cu)
* decode attention      (decode_attn.py, csrc/decode_attn.cu)
* PNM page scoring      (pnm_score.py,   csrc/pnm_score.cu)

``build.py`` compiles them with ``nvcc`` at first use and counts launches.
"""

from . import bitplane, build, decode_attn, lz4, pnm_score

__all__ = ["bitplane", "build", "decode_attn", "lz4", "pnm_score"]
