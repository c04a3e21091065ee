"""The port's tuning helpers (the byte budgets of ``probe``)."""
