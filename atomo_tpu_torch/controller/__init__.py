"""The global controller's artifact (the controller is ROADMAP queue 1 item 12)."""
