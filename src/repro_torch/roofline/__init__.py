"""Roofline terms of a step on the H100 (port of ``repro.roofline``)."""
