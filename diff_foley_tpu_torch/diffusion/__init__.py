"""Noise schedule, DPM-Solver++ multistep sampling and guidance."""
