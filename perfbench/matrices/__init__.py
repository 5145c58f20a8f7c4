"""Matrix generators, one module a generator, found by the ``generator``
name in a configuration file.  Each returns ``(shape, rows, cols, values)``
as numpy arrays, sorted by row and then column, built from the
configuration's sizes alone."""
