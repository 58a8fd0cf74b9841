"""Random samplers for stochastic transforms (the RCN baseline's
`data/rand.py`), copied from `smilecode_tpu/data/rand.py`: each draws from
Python's `random`, call for call as the JAX package's do."""

import random


class Uniform:
    def __init__(self, a, b):
        self.a, self.b = a, b

    def sample(self):
        return random.uniform(self.a, self.b)


class Gaussian:
    def __init__(self, mean, std):
        self.mean, self.std = mean, std

    def sample(self):
        return random.gauss(self.mean, self.std)


class Constant:
    def __init__(self, val):
        self.val = val

    def sample(self):
        return self.val
