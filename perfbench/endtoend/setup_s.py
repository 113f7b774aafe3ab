"""Process start to the first timed unit: imports, the CUDA context, the
kernel libraries (built only in a checkout's first run), the inputs made
from the seed and the warm-up of every pool dataset."""


def read(window):
    return window.setup_s
