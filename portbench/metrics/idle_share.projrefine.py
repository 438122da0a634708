"""% of the traced window in which no operation ran on the card."""
from portbench.lib.readers import idle_share as read  # noqa: F401
