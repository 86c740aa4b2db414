"""Small shared utilities: TOML emission and value conversions (the port's
copies of the reference's ``testground_tpu/utils``; Python 3.12's
``tomllib`` takes the place of its ``utils/compat.py``)."""
