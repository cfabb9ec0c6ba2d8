"""Launchers of the port (``serve``)."""
