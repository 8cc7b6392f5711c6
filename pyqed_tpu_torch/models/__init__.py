from .named import FMO
