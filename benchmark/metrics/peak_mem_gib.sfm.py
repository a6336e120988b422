"""Peak device memory allocated in the window (the counter reset before it)."""
from benchmark.readers import peak_gib as read  # noqa: F401
