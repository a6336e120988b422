"""Share of the traced window's device timeline (first operation to last) in
which no operation ran, in the query cells (rank 0 on several chips)."""
from benchmark.readers import idle_pct as read  # noqa: F401
