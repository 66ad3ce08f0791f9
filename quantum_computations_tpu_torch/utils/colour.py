"""ANSI terminal colour helper (counterpart of
``quantum_computations_tpu/utils/colour.py``; parity with reference
``impact_.../colour.py``)."""


class Colour:
    BLACK = "\033[30m"
    RED = "\033[31m"
    GREEN = "\033[32m"
    YELLOW = "\033[33m"
    BLUE = "\033[34m"
    MAGENTA = "\033[35m"
    CYAN = "\033[36m"
    WHITE = "\033[37m"
    BOLD = "\033[1m"
    UNDERLINE = "\033[4m"
    RESET = "\033[0m"

    @classmethod
    def wrap(cls, text: str, *styles: str) -> str:
        return "".join(styles) + text + cls.RESET
