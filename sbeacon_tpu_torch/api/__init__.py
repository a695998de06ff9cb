from .app import BeaconApp
from .server import make_server, serve

__all__ = ["BeaconApp", "make_server", "serve"]
