"""Example drives of the planner (the reference's main_min_example.py and
main_std_example.py): run each as
``python -m graphbasedlocaltrajectoryplanner_torch.examples.<name>``."""
