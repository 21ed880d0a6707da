"""TRACE core of the port: bit-plane substrate (``bitplane``), KV
transform (``kv_transform``), elastic precision (``precision``), codecs
(``codec``) and the tier device (``tier``)."""
