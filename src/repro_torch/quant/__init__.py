"""Serving-side surgery on packed parameter trees (``surgery``), and the
quantization pipeline's fault injection (``faults``) and input checks
(``preflight``)."""
