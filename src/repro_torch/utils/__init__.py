"""Utilities (counterpart of the JAX package's ``utils/``): ``comms``, the
collective, operation and byte accounting of an eager step, where the JAX
package's ``hlo`` parses the same figures out of a compiled HLO module."""
