"""flax->torch parameter conversion, seeded random weights, WAV output."""
