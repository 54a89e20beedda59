"""Planning: hardware presets, the EB model, the planner and tiering."""
