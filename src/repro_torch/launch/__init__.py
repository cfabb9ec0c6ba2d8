"""Launchers of the port (``serve``, ``train``) and the shapes of their
inputs (``specs``)."""
