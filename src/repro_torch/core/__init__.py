"""The search half of the port: genome, scorer, agent, operators, supervisor,
lineage and the serial evolution loop (a subset of ``repro.core``)."""
from repro_torch.core.agent import AgentPolicy, Directive, ScriptedAgent, VariationResult
from repro_torch.core.evals import InlineBackend, ScoreCache, ScoreVector, Scorer
from repro_torch.core.evolution import ContinuousEvolution, EvolutionReport
from repro_torch.core.islands import Island
from repro_torch.core.knowledge import KnowledgeBase
from repro_torch.core.perfmodel import (BenchConfig, decode_suite, estimate,
                                        gqa_suite, mha_suite, suite_by_name)
from repro_torch.core.population import Commit, Lineage
from repro_torch.core.search_space import KernelGenome, seed_genome
from repro_torch.core.supervisor import Supervisor
from repro_torch.core.toolbelt import RefutedMemory, Toolbelt
from repro_torch.core.variation import (AgenticVariationOperator,
                                        PlanExecuteSummarize,
                                        SingleShotMutation, make_operator)

__all__ = [
    "AgentPolicy", "Directive", "ScriptedAgent", "VariationResult",
    "InlineBackend", "ScoreCache", "ScoreVector", "Scorer",
    "ContinuousEvolution", "EvolutionReport", "Island", "KnowledgeBase",
    "BenchConfig", "decode_suite", "estimate", "gqa_suite", "mha_suite",
    "suite_by_name", "Commit", "Lineage", "KernelGenome", "seed_genome",
    "Supervisor", "RefutedMemory", "Toolbelt", "AgenticVariationOperator",
    "PlanExecuteSummarize", "SingleShotMutation", "make_operator",
]
