"""The HTTP serving surface: ``server`` (routes and contract) on ``_http``
(the standard library's threading HTTP server)."""
