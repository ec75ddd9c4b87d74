from repro_torch.core.agents.base import (AGENT_HYPER, Agent, KNOWN_AGENTS,
                                    make_agent)
from repro_torch.core.agents.random_walk import RandomWalker
from repro_torch.core.agents.genetic import GeneticAlgorithm
from repro_torch.core.agents.aco import AntColony
from repro_torch.core.agents.bayesian import BayesianOptimizer
from repro_torch.core.agents.surrogate import SurrogateScreeningAgent

__all__ = ["Agent", "make_agent", "KNOWN_AGENTS", "AGENT_HYPER",
           "RandomWalker", "GeneticAlgorithm", "AntColony",
           "BayesianOptimizer", "SurrogateScreeningAgent"]
