from .optim import Optimizer, adamw, sgd
