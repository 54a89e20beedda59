"""Dense decoder layers, the model entry points and the operand registry."""
