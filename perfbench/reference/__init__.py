"""Plain PyTorch references, one module a solver family, found by the
``reference`` name in a configuration file.  They import nothing of the
program: each works its operator, preconditioner and solve out again from
the arrays the benchmark generated."""
