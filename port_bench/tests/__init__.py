"""CPU tests of the benchmark (cards tests are marked `cuda` and skip without one)."""
