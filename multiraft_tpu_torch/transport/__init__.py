"""The wire codec (``transport.codec``), byte-compatible with the
reference package's."""
