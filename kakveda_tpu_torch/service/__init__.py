"""The port's service plane: the aiohttp API over the torch ``Platform``.

``python -m kakveda_tpu_torch.service`` starts it (see ``main.py``); only
this subpackage imports ``aiohttp``.
"""
