"""The port's benchmark: one cell (a model configuration under a traffic
mix) per run, driven through the serving engine.  `run.py` is the command."""
