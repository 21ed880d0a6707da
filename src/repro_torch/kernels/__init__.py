"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version (taken for tensors on the CPU):

* bit-plane pack/unpack (bitplane.py,       csrc/bitplane_pack.cu,
                                            csrc/bitplane_unpack.cu)
* LZ4 match prep        (lz4.py,            csrc/lz4_prep.cu)
* LZ4 match, from bytes (lz4.py,            csrc/lz4_match.cu)
* decode attention      (decode_attn.py,    csrc/decode_attn.cu)
* PNM page scoring      (pnm_score.py,      csrc/pnm_score.cu)
* KV exponent delta     (kv_delta.py,       csrc/kv_delta.cu)
* elastic dequant matmul (elastic_matmul.py, csrc/elastic_matmul.cu)

``ops.py`` is the public kernel API, the twin of the reference's
``kernels.ops`` (``bitplane_pack``, ``elastic_unpack``, ``kv_transform``,
``kv_transform_inv``, ``elastic_matmul``, ``decode_attention``); it is not
re-exported here, where ``elastic_matmul`` names the module.  ``build.py``
compiles the kernels with ``nvcc`` at first use and counts launches.
"""

from . import (
    bitplane, build, decode_attn, elastic_matmul, kv_delta, lz4, ops,
    pnm_score,
)

__all__ = ["bitplane", "build", "decode_attn", "elastic_matmul", "kv_delta",
           "lz4", "ops", "pnm_score"]
