"""Networks and their parameters."""
