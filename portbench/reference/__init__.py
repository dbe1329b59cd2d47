"""Plain PyTorch reference of what the cells compute; imports nothing of the program."""
