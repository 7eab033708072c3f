"""Utilities of the port: stage timers and the device trace."""
