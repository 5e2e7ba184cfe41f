"""Data of the port (mirror of ``repro/data``): the synthetic Markov
stream the trainer learns."""
