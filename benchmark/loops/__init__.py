"""Traffic generators, one module a ``loop`` that a mix names."""
