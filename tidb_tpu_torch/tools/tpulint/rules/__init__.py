"""Rule modules register themselves on import."""
from . import dispatch     # noqa: F401
from . import purity       # noqa: F401
from . import race         # noqa: F401
from . import hygiene      # noqa: F401
from . import codes        # noqa: F401
from . import hostsync     # noqa: F401
from . import imports      # noqa: F401
from . import failpoints   # noqa: F401
from . import locks        # noqa: F401
