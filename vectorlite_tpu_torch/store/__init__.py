"""The SDK's client and collections. Importing the package installs the
range around full GC passes (``observability.install_gc_span``)."""

from ..observability import install_gc_span

install_gc_span()
