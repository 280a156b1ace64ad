"""Step functions and the training driver of the port's LM."""
