"""Version information of heat_tpu_torch (the reference's ``core/version.py``)."""

major: int = 0
minor: int = 1
micro: int = 0
extension: str = None

if not extension:
    __version__ = f"{major}.{minor}.{micro}"
else:
    __version__ = f"{major}.{minor}.{micro}-{extension}"
