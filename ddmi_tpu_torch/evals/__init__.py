"""Evaluation networks of the port."""
