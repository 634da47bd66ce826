"""The benchmark's plain reference: the three networks, the geometry, the
warps, the losses, the solver and the PNG decode plus resize of the data
path, written in plain PyTorch and NumPy.

It is a frozen copy of what the system computes, kept here so that later
changes to the system are judged against a yardstick they cannot move.
It imports nothing of the system under test and nothing of the JAX
package (``gpubench/tests/test_gpubench_guard.py`` checks both).
"""
