"""Execution helpers (input dtype validation)."""
