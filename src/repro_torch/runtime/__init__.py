"""Runtime bookkeeping shared by the serving layer."""
