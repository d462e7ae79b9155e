"""Builders of each configuration family: the inputs a run makes from its
seed (weights, target, first candidates), the port's problem built from
them as its entry point builds it, and the plain reference over the same
inputs. A family is found by the ``problem`` key of a configuration."""
