"""The benchmark's harness: traffic, the clock around the program, the
trace, and the comparison with the reference."""
