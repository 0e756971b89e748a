"""Multitask models of the port."""
