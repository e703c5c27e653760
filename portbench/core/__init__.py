"""The harness: set-up, window, trace, comparison."""
