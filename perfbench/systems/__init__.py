"""Constructors of the system under test: each takes a configuration and returns
the program's own objects. Only these, ``entries/`` and the correctness hooks
they call import the program."""
