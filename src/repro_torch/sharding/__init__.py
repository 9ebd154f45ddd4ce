"""Logical-axis sharding rules and mesh plans (the pure part of the JAX
package's ``repro.sharding``)."""
from .specs import (DEFAULT_PLANS, PLAN_AXES, MeshPlan, ShardingRules,
                    default_rules, parse_plan, plan_rules)

__all__ = ["DEFAULT_PLANS", "PLAN_AXES", "MeshPlan", "ShardingRules",
           "default_rules", "parse_plan", "plan_rules"]
