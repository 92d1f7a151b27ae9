"""Host utilities: image preprocessing, weight loading, device selection."""
