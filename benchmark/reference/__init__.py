"""The benchmark's plain reference: one module per env family, in plain
PyTorch, importing nothing of the program under test. A configuration file
names its module under ``reference``."""
