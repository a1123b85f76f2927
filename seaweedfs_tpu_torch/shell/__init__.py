"""Admin shell package: importing it registers every command."""

from . import alert_commands as alert_commands  # noqa: F401
from . import autoscale_commands as autoscale_commands  # noqa: F401
from . import commands as commands  # noqa: F401
from . import coordinator_commands as coordinator_commands  # noqa: F401
from . import ec_commands as ec_commands  # noqa: F401
from . import heat_commands as heat_commands  # noqa: F401
from . import ledger_commands as ledger_commands  # noqa: F401
from . import trace_commands as trace_commands  # noqa: F401
from . import volume_commands as volume_commands  # noqa: F401
from . import workload_commands as workload_commands  # noqa: F401
from .commands import COMMANDS, CommandEnv, repl, run_command  # noqa: F401
