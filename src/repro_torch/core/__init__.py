"""The search half of the port: genome, scorer, agent, operators, supervisor,
lineage, the serial evolution loop and the island engine with its
configuration and migration topologies (``repro.core`` without the cascade
and the search frontier)."""
from repro_torch.core.agent import AgentPolicy, Directive, ScriptedAgent, VariationResult
from repro_torch.core.config import (EngineConfig, EvalConfig, MigrationConfig,
                                     engine_config_from_legacy)
from repro_torch.core.evals import InlineBackend, ScoreCache, ScoreVector, Scorer
from repro_torch.core.evolution import ContinuousEvolution, EvolutionReport
from repro_torch.core.islands import (Archipelago, Island, IslandEvolution,
                                      IslandReport, IslandSpec,
                                      PrefetchAllocator, default_specs,
                                      scenario_specs)
from repro_torch.core.knowledge import KnowledgeBase
from repro_torch.core.knowledge_h100 import HOPPER_FACTS, knowledge_for
from repro_torch.core.perfmodel import (BenchConfig, decode_suite, estimate,
                                        gqa_suite, mha_suite, register_suite,
                                        registered_suites, suite_by_name,
                                        unregister_suite)
from repro_torch.core.perfmodel_h100 import estimate as estimate_h100
from repro_torch.core.population import Commit, Lineage
from repro_torch.core.search_space import KernelGenome, seed_genome
from repro_torch.core.supervisor import Supervisor
from repro_torch.core.toolbelt import RefutedMemory, Toolbelt
from repro_torch.core.topology import (TOPOLOGIES, AdaptiveTopology,
                                       AllToAllTopology, ExplicitTopology,
                                       MigrationStats, MigrationTopology,
                                       RingTopology, StarTopology,
                                       make_topology, topology_names)
from repro_torch.core.variation import (AgenticVariationOperator,
                                        PlanExecuteSummarize,
                                        SingleShotMutation, make_operator)

__all__ = [
    "AgentPolicy", "Directive", "ScriptedAgent", "VariationResult",
    "EngineConfig", "EvalConfig", "MigrationConfig",
    "engine_config_from_legacy",
    "InlineBackend", "ScoreCache", "ScoreVector", "Scorer",
    "ContinuousEvolution", "EvolutionReport", "KnowledgeBase",
    "Archipelago", "Island", "IslandEvolution", "IslandReport", "IslandSpec",
    "PrefetchAllocator", "default_specs", "scenario_specs",
    "HOPPER_FACTS", "knowledge_for",
    "BenchConfig", "decode_suite", "estimate", "estimate_h100", "gqa_suite",
    "mha_suite", "register_suite", "registered_suites", "unregister_suite",
    "suite_by_name", "Commit", "Lineage", "KernelGenome", "seed_genome",
    "Supervisor", "RefutedMemory", "Toolbelt", "AgenticVariationOperator",
    "PlanExecuteSummarize", "SingleShotMutation", "make_operator",
    "AdaptiveTopology", "AllToAllTopology", "ExplicitTopology",
    "MigrationStats", "MigrationTopology", "RingTopology", "StarTopology",
    "TOPOLOGIES", "make_topology", "topology_names",
]
