from .davidson import davidson, block_davidson
