from .fleet import (batched_mpc, fleet_summary, make_scenario_batch, scenario_mesh,
                    sharded_fleet_summary, sharded_mpc)
from .mesh import fleet_mesh, init_distributed, scaling_report
from .tensor import dp_tp_rollout, op_mesh, row_sharded_predict, row_sharded_rollout, tp_model_fns
