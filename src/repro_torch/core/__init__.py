"""TRACE core of the port: bit-plane substrate (``bitplane``), KV
transform (``kv_transform``), elastic precision (``precision``), codecs
(``codec``), the tier device (``tier``) and fleets of it (``sharding``),
and the serving traces (``synth``)."""
