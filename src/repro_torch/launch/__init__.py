"""Launchers of the port: ``lm_serve`` (the LM decode loop)."""
