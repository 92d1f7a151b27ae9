"""End-to-end inference: padded image batch -> text-line records."""
