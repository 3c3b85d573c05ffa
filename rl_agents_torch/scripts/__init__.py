"""The study scripts of the PyTorch port: ``python -m
rl_agents_torch.scripts.planners_evaluation`` (planner efficiency),
``planners_robust_evaluation`` (robust agents) and
``planners_visualization`` (planner trees)."""
