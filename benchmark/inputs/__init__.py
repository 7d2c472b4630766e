"""Frozen input makers: the benchmark's own copies, so that a change to the
program cannot move what the benchmark feeds it."""
