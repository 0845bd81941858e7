"""Host runtime of the port: codecs, record streams, comparators, config,
logging, errors, metrics and the retry policy (copies of
``uda_tpu/utils``'s modules, see uda_tpu_torch/__init__.py)."""
