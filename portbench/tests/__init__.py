"""Tests of the harness (python -m pytest portbench/tests from the root)."""
