"""Training and evaluation steps (the evaluation step so far)."""
