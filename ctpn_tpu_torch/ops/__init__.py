"""Geometry ops: anchors, box decode, greedy NMS, proposal layer."""
