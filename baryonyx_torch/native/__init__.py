"""The native (C++) LP parser, with the pure-Python parser as its twin.

``lp_parser.cpp`` is compiled with ``g++`` at first use into
``build/native/`` at the root of the checkout, keyed by the source's hash,
and bound with ``ctypes``. Where no compiler is found the library is
absent and the callers (io/lp_parse.py) use the Python parser, which
gives the same result.
"""

from baryonyx_torch.native.build import load_library, native_available
from baryonyx_torch.native.lp import parse_lp_native, parse_lp_string_native
