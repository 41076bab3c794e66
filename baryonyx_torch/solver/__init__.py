"""The optimize driver (L5 of the reference architecture).

reference: lib/src/itm-optimizer-common.hpp (multi-start optimize mode),
lib/src/itm.hpp (dispatch).
"""
