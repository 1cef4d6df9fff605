"""Runtime analysis of the port: the lock-order witness
(analysis/lockdep.py). The JAX package's static rules (R1-R13) are not
ported."""
