"""Multi-device paths (counterpart of ``libsdr_tpu.parallel``).  Only the
single-device half of ``wideband`` is ported: its builders take one device,
and a group of devices raises ``ConfigError``."""
