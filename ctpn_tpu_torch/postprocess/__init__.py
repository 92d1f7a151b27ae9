"""H-mode text-line connector, detector facade, line-union pass."""
