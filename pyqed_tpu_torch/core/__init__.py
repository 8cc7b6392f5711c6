from .result import Result, load_result
