"""Share of the traced window's device timeline (first operation to last) in
which no operation ran, in the training cell."""
from benchmark.readers import idle_pct as read  # noqa: F401
