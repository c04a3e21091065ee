"""Quorum aggregation's artifacts (the mode itself is ROADMAP queue 1 item 9)."""
