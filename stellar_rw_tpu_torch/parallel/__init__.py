"""Parallel execution of the port: the data-parallel trainer's slots and
reduction (dp.py)."""
