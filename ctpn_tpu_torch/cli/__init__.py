"""Command-line entry points of the port (so far: ``serve``)."""
