"""Command-line drivers of the port: ``launch.serve`` (batched serving
from a packed artifact, with snapshot and crash-restart) and
``launch.supervisor`` (bounded restarts and hang detection)."""
