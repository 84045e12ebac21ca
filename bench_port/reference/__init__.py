"""Plain references of the benchmark's configurations, one module each,
named by a configuration's ``reference`` key, and ``merge``, the
screening's clusterings, which every configuration shares. They import
torch, numpy and the standard library only: nothing of the program under
test and nothing of JAX."""
