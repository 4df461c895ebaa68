"""The benchmark's harness: it finds a cell's configuration, traffic kind
and metrics by name, runs the program under test, and reads the trace."""
