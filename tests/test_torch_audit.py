"""The audit of the JAX package's tests against the port's.

``MAP`` holds, for every test function of the 14 JAX test files (class
methods as ``Class::name``), the port tests that make its check, each as
``"test_torch_x.py::[Class::]name"``. A port test makes a JAX test's check
when it asserts the same properties of the port's own result, or holds
the port's result equal to the JAX package's result that the JAX test
asserts them of (the comments say which, where it is not plain). An entry
holds a reason instead only for a JAX test with nothing to hold: a
placeholder whose body is ``pass``.

This file checks the map's shape with ``ast`` (nothing is imported): every
JAX test has an entry and no entry is stale, every named port test
exists, reasons stand only for placeholders, and a port test that carries
a JAX test's own name is named in that test's entry. Whether each named
port test makes the check is the map's claim, which its comments
explain where it is not plain.

To add an entry: name the new JAX test as ``"test_x.py::name"`` (or
``"test_x.py::Class::name"``) and list the port tests that hold its check;
write a counterpart in ``tests/test_torch_*.py`` first if none does.
"""
import ast
import glob
import os

import pytest

ROOT = os.path.dirname(os.path.abspath(__file__))
JAX_FILES = ("test_graphguard", "test_from_jaxpr", "test_api", "test_obs",
             "test_explain", "test_substrate", "test_arch_smoke",
             "test_runtime", "test_modelcheck", "test_gradcheck",
             "test_servecheck", "test_serve_numeric", "test_kernels",
             "test_docs")
REASON = "placeholder: "

G = "test_torch_graphguard.py::"
API = "test_torch_api.py::"
OBS = "test_torch_obs.py::"
XP = "test_torch_explain.py::"
FN = "test_torch_functions.py::"
CAP = "test_torch_capture.py::"
SUITE = "test_torch_suite.py::"
RT = "test_torch_runtime.py::"
MC = "test_torch_modelcheck.py::"
GC = "test_torch_gradcheck.py::"
SC = "test_torch_servecheck.py::"
SCR = "test_torch_servecheck_runtime.py::"
SCSP = "test_torch_servecheck_sp.py::"
TR = "test_torch_train.py::"
FP = "test_torch_families_parity.py::"
DOC = "test_torch_docs.py::"
VER = "test_torch_verify.py::"

MAP = {
    # -- test_graphguard.py: the hand-built e-graphs run in both engines
    # (same merges, extractions, node counts, fires); the registered cases
    # on the port's own capture, against the JAX run_case
    "test_graphguard.py::test_clean_case_certificate": [
        API + "test_run_case_is_the_jax_run_case",
        CAP + "test_clean_case_matches_golden"],
    "test_graphguard.py::test_certificate_numeric_replay_tp": [
        G + "test_certificate_numeric_replay_tp",
        CAP + "test_certificate_replays_numerically"],
    "test_graphguard.py::test_bug_detected": [
        G + "test_bug_detected", CAP + "test_bug_surfaces_as_jax"],
    "test_graphguard.py::test_bug5_unexpected_relation": [
        G + "test_bug5_unexpected_relation"],
    "test_graphguard.py::test_paper_running_example": [
        G + "test_paper_running_example"],
    "test_graphguard.py::test_saturate_after_interleaved_merges": [
        G + "test_saturate_after_interleaved_merges"],
    "test_graphguard.py::test_incremental_extraction_after_feasibility_merge":
        [G + "test_incremental_extraction_after_feasibility_merge"],
    "test_graphguard.py::test_certificate_stats_phases": [
        G + "test_certificate_stats_phases"],
    "test_graphguard.py::test_optimizations_behaviour_preserving": [
        G + "test_optimizations_behaviour_preserving"],
    # the two hypothesis properties draw the same examples into both
    "test_graphguard.py::test_matmul_block_lemma_sound": [
        G + "test_matmul_block_lemma_sound"],
    "test_graphguard.py::test_egraph_merge_find_invariants": [
        G + "test_egraph_merge_find_invariants"],
    "test_graphguard.py::test_property_suite_requires_hypothesis":
        REASON + "a skip standing in for the two hypothesis properties "
        "when hypothesis is absent; it checks nothing",
    "test_graphguard.py::test_nary_add_normal_form": [
        G + "test_nary_add_normal_form"],
    "test_graphguard.py::test_add_n_flattens_and_evaluates": [
        G + "test_add_n_flattens_and_evaluates"],
    "test_graphguard.py::test_dus_concat_lemma": [
        G + "test_dus_concat_lemma"],
    # the JAX test's chain has its full write at the head (dus_full's
    # case); the port adds one with it below the tiles, which only the
    # refusal itself stops
    "test_graphguard.py::test_dus_concat_rejects_full_buffer_write": [
        G + "test_dus_concat_rejects_full_buffer_write",
        G + "test_dus_concat_refuses_a_full_write_below_the_tiles"],
    "test_graphguard.py::test_dus_concat_out_of_order_chain_sorts_by_position":
        [G + "test_dus_concat_out_of_order_chain_sorts_by_position"],
    "test_graphguard.py::test_dus_concat_bails_on_chain_not_starting_at_zero":
        [G + "test_dus_concat_bails_on_chain_not_starting_at_zero"],
    "test_graphguard.py::test_reduce_reshape_lemma": [
        G + "test_reduce_reshape_lemma"],
    "test_graphguard.py::test_scalar_factor_lemma_constrained": [
        G + "test_scalar_factor_lemma_constrained"],
    "test_graphguard.py::test_affine_solver": [G + "test_affine_solver"],
    "test_graphguard.py::test_scaling_with_degree": [
        G + "test_scaling_with_degree"],
    "test_graphguard.py::test_spmd_expansion_semantics": [
        G + "test_spmd_expansion_semantics"],

    # -- test_from_jaxpr.py: both frontends are strict by default and keep
    # an unknown op as an opaque term when lenient; by design the port's
    # opaque term is named by its aten op (``opaque:aten.sort``, jaxpr's
    # ``opaque:sort``), and make_fx unrolls a loop where jax has a scan
    # with an unroll budget
    "test_from_jaxpr.py::test_byte_identical_certificates": [
        FN + "test_byte_identical_certificates"],
    # the port's cross-check is parametrized over all 11 cases
    "test_from_jaxpr.py::test_cross_check_covers_at_least_six_cases": [
        FN + "test_byte_identical_certificates"],
    # common part: the refusal names the primitive and the reason; the
    # port captures the unrolled loop as the JAX capture of the jnp loop
    "test_from_jaxpr.py::test_over_budget_scan_names_primitive_and_source": [
        FN + "test_loop_recurrence_unrolls_where_jax_scan_is_over_budget",
        FN + "test_unsupported_op_names_its_source"],
    "test_from_jaxpr.py::"
    "test_unknown_primitive_raises_strict_and_is_opaque_lenient": [
        FN + "test_unknown_primitive_raises_strict_and_is_opaque_lenient",
        FN + "test_register_lemma_on_an_opaque_op",
        FN + "test_cli_fn_strict_key",
        CAP + "test_unsupported_op_names_the_users_line"],
    "test_from_jaxpr.py::test_strict_spmd_capture_raises_too": [
        FN + "test_unsupported_op_names_its_source"],
    "test_from_jaxpr.py::test_strict_hook_is_scoped": [
        FN + "test_strict_hook_is_scoped"],
    "test_from_jaxpr.py::test_supported_primitives_is_a_real_vocabulary": [
        FN + "test_supported_primitives_is_a_real_vocabulary"],
    "test_from_jaxpr.py::test_source_location_is_best_effort": [
        FN + "test_source_location_is_best_effort"],
    "test_from_jaxpr.py::test_verify_functions_certificate": [
        FN + "test_verify_functions_verdicts"],
    "test_from_jaxpr.py::test_verify_functions_refinement_error_localizes": [
        FN + "test_verify_functions_verdicts"],
    "test_from_jaxpr.py::test_verify_functions_unsupported_becomes_error_verdict":
        [FN + "test_unsupported_op_names_its_source"],
    "test_from_jaxpr.py::test_example_args_instead_of_avals": [
        FN + "test_verify_functions_verdicts"],
    "test_from_jaxpr.py::test_caller_mistakes_raise_not_verdict": [
        FN + "test_caller_mistakes_raise_not_verdict"],
    "test_from_jaxpr.py::test_function_spec_defaults": [
        FN + "test_function_spec_defaults"],
    "test_from_jaxpr.py::test_default_input_names_fallback": [
        FN + "test_default_input_names_fallback"],
    "test_from_jaxpr.py::test_normalize_mesh_forms": [
        FN + "test_normalize_mesh_forms"],
    "test_from_jaxpr.py::test_cli_fn_example_task": [
        FN + "test_cli_fn_example_task"],
    "test_from_jaxpr.py::test_cli_fn_bad_target_is_harness_error": [
        FN + "test_cli_fn_harness_errors_exit_2"],
    "test_from_jaxpr.py::test_cli_fn_excludes_case_flags": [
        FN + "test_cli_fn_harness_errors_exit_2"],

    # -- test_api.py: caller mistakes raise the JAX class and message
    "test_api.py::test_registry_covers_paper_matrix": [
        CAP + "test_same_case_matrix_as_jax"],
    "test_api.py::test_duplicate_registration_raises": [
        API + "test_duplicate_registration_raises"],
    "test_api.py::test_duplicate_bug_name_raises": [
        API + "test_duplicate_bug_name_raises"],
    "test_api.py::test_register_rejects_bad_expectation": [
        API + "test_register_rejects_bad_expectation"],
    "test_api.py::test_unknown_names_raise": [
        API + "test_unknown_names_raise"],
    "test_api.py::test_wrong_host_bug_guard": [
        API + "test_wrong_host_bug_guard"],
    "test_api.py::test_legacy_cases_view_mirrors_registry": [
        API + "test_legacy_cases_view_mirrors_registry"],
    "test_api.py::test_spec_is_frozen_and_stamped": [
        API + "test_spec_is_frozen_and_stamped"],
    "test_api.py::test_spec_iterates_as_legacy_6tuple": [
        API + "test_spec_iterates_as_legacy_6tuple"],
    "test_api.py::test_degree_normalization_and_tokens": [
        API + "test_degree_normalization_and_tokens"],
    "test_api.py::test_parse_degree_cli_values": [
        API + "test_parse_degree_cli_values"],
    "test_api.py::test_tuple_degree_rejected_for_single_axis_cases": [
        API + "test_tuple_degree_rejected_for_single_axis_cases"],
    "test_api.py::test_axis_degrees_broadcast_and_mismatch": [
        API + "test_axis_degrees_broadcast_and_mismatch"],
    "test_api.py::test_multiaxis_spec_stamping_and_legacy_tuple": [
        API + "test_multiaxis_spec_stamping_and_legacy_tuple"],
    "test_api.py::test_multiaxis_report_json_roundtrip": [
        API + "test_multiaxis_report_json_roundtrip"],
    "test_api.py::test_suite_sweeps_tuple_degrees_from_registry": [
        API + "test_suite_sweeps_tuple_degrees_from_registry"],
    "test_api.py::test_fsdp_bugs_detected": [
        API + "test_fsdp_bugs_detected",
        CAP + "test_counts_against_jax_capture"],
    "test_api.py::test_pp_dropped_microbatch_detected": [
        API + "test_pp_dropped_microbatch_detected",
        CAP + "test_counts_against_jax_capture"],
    "test_api.py::test_tp_dp_2d_wrong_axis_detected": [
        API + "test_tp_dp_2d_wrong_axis_detected"],
    "test_api.py::test_tp_dp_2d_degree4_axes": [
        API + "test_tp_dp_2d_degree4_axes",
        CAP + "test_counts_against_jax_capture"],
    # verify() on every registered case and bug: the verdicts (and R_o or
    # localization) equal to the golden file's and the JAX verify's
    "test_api.py::test_verify_roundtrip_every_strategy": [
        CAP + "test_clean_case_matches_golden"],
    "test_api.py::test_verify_every_bug_through_registry": [
        CAP + "test_bug_surfaces_as_jax"],
    "test_api.py::test_verify_rejects_selectors_with_prebuilt_spec": [
        API + "test_verify_rejects_selectors_with_prebuilt_spec"],
    "test_api.py::test_suite_rejects_bad_bug_filters": [
        API + "test_suite_rejects_bad_bug_filters"],
    "test_api.py::test_report_json_roundtrip": [
        API + "test_report_json_roundtrip"],
    "test_api.py::test_engine_opts_restored_after_verify": [
        API + "test_engine_opts_restored_after_verify"],
    "test_api.py::test_suite_matrix_shape": [API + "test_suite_matrix_shape"],
    # the port's in-process matrix against the JAX Suite's, every task
    "test_api.py::test_suite_sequential_clean_matrix": [
        SUITE + "test_suite_matches_the_jax_suite"],
    # the golden holds R_o up to a renaming of t<N> names (fx and jaxpr
    # number their defs differently)
    "test_api.py::test_suite_matches_checked_in_golden": [
        CAP + "test_clean_case_matches_golden",
        SUITE + "test_cli_check_holds_r_o_up_to_renaming"],
    "test_api.py::test_suite_deterministic_across_workers_and_opt": [
        API + "test_suite_deterministic_across_opt",
        SUITE + "test_pooled_suite_equals_in_process"],
    "test_api.py::test_suite_per_task_timeout": [
        API + "test_suite_per_task_timeout"],

    # -- test_obs.py
    "test_obs.py::test_span_nesting_well_formed": [
        OBS + "test_span_nesting_well_formed"],
    "test_obs.py::test_module_level_api_is_noop_when_off": [
        OBS + "test_module_level_api_is_noop_when_off"],
    "test_obs.py::test_chrome_trace_loads_and_has_engine_spans": [
        OBS + "test_chrome_trace_loads_and_has_engine_spans"],
    "test_obs.py::test_worker_spans_merge_with_distinct_pids": [
        SUITE + "test_pooled_trace_has_one_track_per_worker",
        "test_torch_pool_trace.py::test_hang_keeps_every_bystanders_span"],
    "test_obs.py::test_certificate_byte_identical_tracing_on_off": [
        OBS + "test_certificate_byte_identical_tracing_on_off"],
    "test_obs.py::test_lemma_stats_deterministic_across_worker_counts": [
        OBS + "test_lemma_stats_deterministic_across_worker_counts"],
    "test_obs.py::test_inspect_render_names_top_lemma": [
        OBS + "test_inspect_render_names_top_lemma"],
    "test_obs.py::test_metrics_registry_and_render": [
        OBS + "test_metrics_registry_and_render"],
    "test_obs.py::test_histogram_reservoir_is_deterministic": [
        OBS + "test_histogram_reservoir_is_deterministic"],
    "test_obs.py::test_cli_trace_does_not_change_envelope_or_certificate": [
        OBS + "test_cli_trace_does_not_change_envelope_or_certificate"],
    "test_obs.py::test_cli_trace_and_metrics_flags": [
        OBS + "test_cli_trace_and_metrics_flags",
        FN + "test_cli_trace_metrics_and_report"],

    # -- test_explain.py
    "test_explain.py::test_off_report_has_no_explanation_key": [
        XP + "test_off_report_has_no_explanation_key"],
    "test_explain.py::test_off_on_certificates_identical": [
        XP + "test_off_on_certificates_identical"],
    "test_explain.py::test_off_family_reports_have_no_explanation_key": [
        XP + "test_off_family_reports_have_no_explanation_key"],
    "test_explain.py::test_explain_enabled_override_beats_env": [
        XP + "test_explain_enabled_override_beats_env"],
    "test_explain.py::test_engine_token_isolates_explain_cache_entries": [
        XP + "test_engine_token_isolates_explain_cache_entries"],
    "test_explain.py::test_chain_replays_outside_egraph": [
        XP + "test_chain_replays_outside_egraph",
        "test_torch_engine.py::test_port_explanation_replays"],
    "test_explain.py::test_replay_rejects_tampered_step": [
        XP + "test_replay_rejects_tampered_step"],
    "test_explain.py::test_chain_deterministic_across_opt_modes": [
        XP + "test_chain_deterministic_across_opt_modes"],
    "test_explain.py::test_chain_deterministic_across_hash_seeds": [
        XP + "test_chain_deterministic_across_hash_seeds"],
    "test_explain.py::test_chain_deterministic_across_worker_counts": [
        XP + "test_chain_deterministic_across_worker_counts"],
    "test_explain.py::test_failure_frontier_names_stuck_op": [
        XP + "test_failure_frontier_names_stuck_op"],
    "test_explain.py::test_failure_frontier_in_family_report": [
        XP + "test_failure_frontier_in_family_report"],
    # the serve explanations themselves equal JAX's in test_torch_servecheck
    "test_explain.py::test_aggregate_explanations_rolls_up": [
        XP + "test_aggregate_explanations_rolls_up",
        SC + "test_explanations_match_jax"],
    "test_explain.py::test_cli_envelope_explanation_key": [
        XP + "test_cli_envelope_explanation_key"],
    "test_explain.py::test_cli_envelope_without_explain_flag": [
        XP + "test_cli_envelope_without_explain_flag"],
    "test_explain.py::test_trace_gzip_roundtrip": [
        XP + "test_trace_gzip_roundtrip"],
    "test_explain.py::test_obs_report_json_stable": [
        XP + "test_obs_report_json_stable"],
    "test_explain.py::test_cli_trace_gz_sibling": [
        XP + "test_cli_trace_gz_sibling"],

    # -- test_substrate.py: the port's data, checkpoints, AdamW and steps
    # equal the JAX package's, and its own training checks
    "test_substrate.py::test_pipeline_deterministic_and_sharded": [
        TR + "test_pipeline_tokens_as_jax"],
    "test_substrate.py::test_checkpoint_roundtrip": [
        TR + "test_checkpoints_are_byte_identical_and_cross"],
    "test_substrate.py::test_adamw_moves_params_toward_gradient": [
        TR + "test_adamw_update_as_jax"],
    "test_substrate.py::test_loss_decreases_tiny_gpt": [
        TR + "test_loss_decreases_tiny_gpt"],
    "test_substrate.py::test_grad_accum_matches_full_batch": [
        TR + "test_grad_accum_matches_full_batch",
        TR + "test_gradients_as_jax_microbatches_and_z_loss"],

    # -- test_arch_smoke.py: every family's logits, decode steps and
    # gradients equal the JAX models' (fp32 2e-4)
    "test_arch_smoke.py::test_forward_shapes_no_nan": [
        FP + "test_prefill_matches_jax",
        FP + "test_other_configs_prefill_and_decode_match_jax"],
    "test_arch_smoke.py::test_train_step_decreases_or_finite": [
        TR + "test_gradients_as_jax", TR + "test_train_step_as_jax"],
    "test_arch_smoke.py::test_decode_step": [
        FP + "test_decode_tokens_match_jax",
        FP + "test_other_configs_prefill_and_decode_match_jax"],

    # -- test_runtime.py
    "test_runtime.py::TestCertificateCache::test_roundtrip_and_stats": [
        RT + "TestCertificateCache::test_roundtrip_and_stats"],
    "test_runtime.py::TestCertificateCache::test_get_returns_defensive_copy":
        [RT + "TestCertificateCache::test_get_returns_defensive_copy"],
    "test_runtime.py::TestCertificateCache::test_torn_tail_line_recovered": [
        RT + "TestCertificateCache::test_torn_tail_line_recovered"],
    "test_runtime.py::TestCertificateCache::"
    "test_garbage_and_bad_digest_lines_skipped": [
        RT + "TestCertificateCache::"
        "test_garbage_and_bad_digest_lines_skipped"],
    "test_runtime.py::TestCertificateCache::test_compact_drops_corruption": [
        RT + "TestCertificateCache::test_compact_drops_corruption"],
    "test_runtime.py::TestCertificateCache::test_engine_fingerprint_rotation":
        [RT + "TestCertificateCache::test_engine_fingerprint_rotation"],
    "test_runtime.py::TestCertificateCache::test_resolve_cache_semantics": [
        RT + "TestCertificateCache::test_resolve_cache_semantics"],
    "test_runtime.py::TestCertificateCache::test_cache_keys_embed_engine_limits":
        [RT + "TestCertificateCache::test_cache_keys_embed_engine_limits"],
    "test_runtime.py::TestCertificateCache::"
    "test_commit_policy_only_deterministic_verdicts": [
        RT + "TestCertificateCache::"
        "test_commit_policy_only_deterministic_verdicts"],
    "test_runtime.py::TestChaos::test_parse_spec": [
        RT + "TestChaos::test_parse_spec"],
    "test_runtime.py::TestChaos::test_should_is_deterministic_and_targeted": [
        RT + "TestChaos::test_should_is_deterministic_and_targeted",
        RT + "test_chaos_draws_match_the_jax_package"],
    "test_runtime.py::TestChaos::test_maybe_fault_is_noop_outside_workers": [
        RT + "TestChaos::test_maybe_fault_is_noop_outside_workers"],
    "test_runtime.py::TestPool::test_inline_execution": [
        RT + "TestPool::test_inline_execution"],
    "test_runtime.py::TestPool::test_inline_task_error_contained": [
        RT + "TestPool::test_inline_task_error_contained"],
    "test_runtime.py::TestPool::test_pool_matches_inline": [
        RT + "TestPool::test_pool_matches_inline_and_contains_task_errors"],
    "test_runtime.py::TestPool::test_duplicate_keys_rejected": [
        RT + "TestPool::test_duplicate_keys_rejected"],
    "test_runtime.py::TestPool::test_per_task_budget_not_shared": [
        RT + "TestPool::test_per_task_budget_not_shared"],
    "test_runtime.py::TestPool::test_crash_blamed_on_victim_only": [
        RT + "TestPool::test_crash_blamed_on_victim_only"],
    "test_runtime.py::TestPool::test_hard_exit_cause_reported": [
        RT + "TestPool::test_hard_exit_cause_reported"],
    "test_runtime.py::TestPool::test_transient_crash_recovers_with_retry": [
        RT + "TestPool::test_transient_crash_recovers_with_retry"],
    "test_runtime.py::TestPool::test_wedged_worker_startup_times_out": [
        RT + "TestPool::test_wedged_worker_startup_times_out"],
    "test_runtime.py::TestPool::test_degrades_inline_when_pool_unavailable": [
        RT + "TestPool::test_degrades_inline_when_pool_unavailable"],
    "test_runtime.py::TestPool::test_worker_chaos_never_fires_in_process": [
        RT + "TestPool::test_worker_chaos_never_fires_in_process"],
    "test_runtime.py::TestPool::test_pool_cache_hit_skips_execution": [
        RT + "TestPool::test_pool_cache_hit_skips_execution"],
    "test_runtime.py::TestPool::test_nondeterministic_verdicts_never_cached": [
        RT + "TestPool::test_nondeterministic_verdicts_never_cached"],
    "test_runtime.py::TestSchedulerFaults::test_suite_crash_survivors_identical":
        [SUITE + "test_suite_crash_charged_to_the_victim_only"],
    "test_runtime.py::TestSchedulerFaults::test_suite_cache_warm_run_identical":
        [SUITE + "test_cache_warm_run_identical_and_torn_line_reproved"],
    "test_runtime.py::TestSchedulerFaults::"
    "test_modelcheck_cache_resume_reproves_only_damaged": [
        RT + "TestSchedulerFaults::"
        "test_modelcheck_cache_resume_reproves_only_damaged"],
    "test_runtime.py::TestSchedulerFaults::"
    "test_modelcheck_crash_localized_to_obligation": [
        RT + "TestSchedulerFaults::"
        "test_modelcheck_crash_localized_to_obligation"],
    # the reference's 4 s budget misses under -n 6; the port's is 10 s
    "test_runtime.py::TestSchedulerFaults::"
    "test_gradcheck_hang_times_out_one_param": [
        RT + "TestSchedulerFaults::test_gradcheck_hang_times_out_one_param"],

    # -- test_modelcheck.py
    "test_modelcheck.py::test_parse_plan": [MC + "test_parse_plan"],
    "test_modelcheck.py::test_plan_rules_drive_specs": [
        MC + "test_plan_rules_drive_specs"],
    "test_modelcheck.py::test_decompose_gpt_block_structure": [
        MC + "test_decompose_gpt_block_structure"],
    "test_modelcheck.py::test_dedup_is_layer_count_invariant": [
        MC + "test_dedup_is_layer_count_invariant"],
    "test_modelcheck.py::test_pattern_roles_split_obligations": [
        MC + "test_pattern_roles_split_obligations"],
    "test_modelcheck.py::test_bug_splits_dedup_class": [
        MC + "test_bug_splits_dedup_class"],
    "test_modelcheck.py::test_unsupported_family_raises": [
        MC + "test_unsupported_family_raises"],
    "test_modelcheck.py::test_unsupported_family_error_is_actionable": [
        MC + "test_unsupported_family_error_is_the_references"],
    "test_modelcheck.py::test_obligation_key_ignores_fn_identity": [
        MC + "test_obligation_key_ignores_fn_identity"],
    "test_modelcheck.py::test_gpt_whole_model_certificate": [
        MC + "test_gpt_whole_model_certificate"],
    "test_modelcheck.py::test_cache_hit_certificate_byte_identical": [
        MC + "test_cache_hit_certificate_byte_identical"],
    "test_modelcheck.py::test_injected_bug_localizes_to_block": [
        MC + "test_injected_bug_localizes_to_block"],
    "test_modelcheck.py::test_moe_model_certificate": [
        MC + "test_moe_model_certificate", MC + "test_capture_parity"],
    "test_modelcheck.py::test_seam_relation_shapes": [
        MC + "test_seam_relation_shapes"],
    "test_modelcheck.py::test_scheduler_pool_matches_inprocess": [
        MC + "test_scheduler_pool_matches_inprocess"],
    "test_modelcheck.py::test_model_report_json_roundtrip": [
        MC + "test_model_report_json_roundtrip"],
    "test_modelcheck.py::test_model_task_registry": [
        MC + "test_model_task_registry"],
    "test_modelcheck.py::test_check_model_task_runs": [
        MC + "test_check_model_task_runs"],
    "test_modelcheck.py::test_cli_model_json_envelope": [
        MC + "test_cli_model_json_envelope_matches_jax"],
    "test_modelcheck.py::test_cli_case_json_envelope": [
        MC + "test_cli_case_json_envelope"],
    "test_modelcheck.py::test_capture_chain_threads_names_and_avals": [
        MC + "test_capture_chain_threads_names_and_avals"],
    "test_modelcheck.py::test_sequential_chain_op_count": [
        MC + "test_sequential_chain_op_count"],

    # -- test_gradcheck.py
    "test_gradcheck.py::test_train_registry_covers_strategies_and_bugs": [
        GC + "test_train_registry_covers_strategies_and_bugs"],
    "test_gradcheck.py::test_train_registry_guards": [
        GC + "test_train_registry_guards"],
    "test_gradcheck.py::test_capture_grad_backward_graph": [
        GC + "test_capture_grad_backward_graph"],
    "test_gradcheck.py::test_grad_collective_transposition": [
        GC + "test_grad_collective_transposition"],
    "test_gradcheck.py::test_expected_grad_relation_terms": [
        GC + "test_expected_grad_relation_terms"],
    # parametrized over every (strategy, degree) the registry declares
    "test_gradcheck.py::test_train_strategy_certifies": [
        GC + "test_train_strategy_certifies_as_jax"],
    "test_gradcheck.py::test_train_strategy_certifies_at_all_degrees": [
        GC + "test_train_strategy_certifies_as_jax"],
    "test_gradcheck.py::test_train_bug_localizes_to_parameter": [
        GC + "test_train_bug_localizes_to_parameter"],
    "test_gradcheck.py::test_train_report_json_roundtrip": [
        GC + "test_train_report_json_roundtrip"],
    "test_gradcheck.py::test_check_train_task_api": [
        GC + "test_check_train_task_api"],
    "test_gradcheck.py::test_json_envelope_all_paths": [
        GC + "test_json_envelope_all_paths"],
    "test_gradcheck.py::test_train_envelope_identical_across_worker_counts": [
        GC + "test_train_envelope_identical_across_worker_counts"],
    "test_gradcheck.py::test_cli_list_kind_tags": [
        GC + "test_cli_list_kind_tags"],

    # -- test_servecheck.py: the port's reports equal the JAX package's
    # (stable summary, R_o, seams, fires) task by task
    "test_servecheck.py::test_serve_registry_covers_strategies_and_bugs": [
        SC + "test_serve_registry_covers_strategies_and_bugs"],
    "test_servecheck.py::test_serve_registry_guards": [
        SC + "test_serve_registry_guards"],
    "test_servecheck.py::test_position_class_dedup_counts": [
        SC + "test_dedup_counts", SC + "test_canonical_keys_and_blocks_as_jax"],
    "test_servecheck.py::test_bug_splits_its_position_class": [
        SC + "test_bug_splits_its_position_class"],
    "test_servecheck.py::test_tp_decode_certifies": [
        SC + "test_serve_task_as_jax"],
    "test_servecheck.py::test_other_strategies_certify": [
        SC + "test_serve_task_as_jax", SCSP + "test_sp_cache_certifies_as_jax"],
    "test_servecheck.py::test_serve_strategy_certifies_at_all_degrees": [
        SC + "test_serve_task_as_jax", SCSP + "test_sp_cache_certifies_as_jax"],
    "test_servecheck.py::test_serve_bug_localizes_to_step": [
        SC + "test_stale_cache_shard_localizes_to_step3",
        SC + "test_cache_gather_wrong_axis_is_an_unexpected_relation_at_step1",
        SCSP + "test_pos_off_by_one_localizes_to_step4"],
    "test_servecheck.py::test_wrong_axis_seam_detail": [
        SC + "test_serve_task_as_jax",
        SC + "test_cache_gather_wrong_axis_is_an_unexpected_relation_at_step1"],
    "test_servecheck.py::test_serve_report_json_roundtrip": [
        SC + "test_serve_report_json_roundtrip"],
    "test_servecheck.py::test_serve_report_identical_across_worker_counts": [
        SCR + "test_identical_reports_across_worker_counts"],
    "test_servecheck.py::test_serve_cache_key_format": [
        SC + "test_dedup_counts", SC + "test_canonical_keys_and_blocks_as_jax"],
    "test_servecheck.py::test_warm_cache_replays_serve_verdicts": [
        SCR + "test_warm_cache_replays_every_verdict"],
    "test_servecheck.py::test_check_serve_task_api": [
        VER + "test_serve_task_kind_runs"],
    "test_servecheck.py::test_json_envelope_serve_path": [
        SCR + "test_serve_envelope_matches_jax"],
    "test_servecheck.py::test_cli_list_serve_rows": [
        SC + "test_cli_list_serve_rows"],

    # -- test_serve_numeric.py: the reference fails its own mixtral case
    # (the parallel prefill's MoE capacity drop at positions 30-31); the
    # port holds prefill against the JAX prefill and sequential prefill
    # against the JAX sequential prefill, and its own gap where no drop is
    "test_serve_numeric.py::test_sequential_prefill_matches_parallel": [
        FP + "test_sequential_prefill_matches_jax",
        FP + "test_sequential_prefill_matches_parallel_in_the_port"],

    # -- test_kernels.py: the Pallas flash kernel no longer runs under
    # jax 0.9.0 (pl.load is gone), so the reference fails these; the port
    # holds its kernels' plain versions and their tile loops against
    # repro.kernels.ref (the cards' kernels against the plain versions in
    # test_torch_cuda.py and chip_smoke.py)
    "test_kernels.py::test_rmsnorm_matches_ref": [
        "test_torch_kernels.py::test_rmsnorm_plain_matches_jax"],
    "test_kernels.py::test_flash_attention_matches_ref": [
        "test_torch_kernels.py::test_flash_plain_matches_jax_ref",
        "test_torch_kernels.py::test_flash_plain_gqa_matches_gqa_attend"],
    "test_kernels.py::test_flash_blocks_sweep": [
        "test_torch_fp32_route.py::test_flash_blocks_sweep",
        "test_torch_fp32_route.py::test_emulated_forward_matches_jax"],

    # -- test_docs.py: ARCHITECTURE.md stays the reference's; the port's
    # architecture is README.md's "Port architecture"
    "test_docs.py::test_every_lemma_is_catalogued": [
        DOC + "test_every_port_lemma_is_catalogued"],
    "test_docs.py::test_no_stale_catalog_entries": [
        DOC + "test_no_catalog_entry_the_port_lacks"],
    "test_docs.py::test_lemma_entries_state_trigger_ops_and_source": [
        DOC + "test_lemma_sources_match_the_catalog"],
    "test_docs.py::test_cli_help_block_in_sync": [
        DOC + "test_cli_help_block_in_sync"],
    "test_docs.py::test_cli_doc_covers_all_paths_and_exit_codes": [
        DOC + "test_port_reference_names_every_path_and_flag",
        DOC + "test_port_reference_states_every_exit_code"],
    "test_docs.py::test_docstring_coverage_gate": [
        DOC + "test_docstring_coverage_gate"],
    "test_docs.py::test_architecture_covers_every_subsystem": [
        DOC + "test_port_architecture_covers_every_subpackage"],
    "test_docs.py::test_architecture_links_resolve": [
        DOC + "test_port_architecture_links_resolve"],
    "test_docs.py::test_observability_doc_covers_every_live_metric": [
        DOC + "test_every_live_metric_is_documented"],
    "test_docs.py::test_observability_doc_names_key_spans": [
        DOC + "test_key_spans_are_documented_and_emitted",
        DOC + "test_port_trace_additions_are_documented"],
}


def _tests_of(tree):
    """``{"[Class::]name": FunctionDef}`` of a module's test functions:
    module level (under ``if``/``else`` too) and methods of classes."""
    out = {}

    def visit(nodes, prefix=""):
        for node in nodes:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if node.name.startswith("test_"):
                    out[prefix + node.name] = node
            elif isinstance(node, ast.ClassDef) and not prefix:
                visit(node.body, node.name + "::")
            elif isinstance(node, (ast.If, ast.Try)):
                visit(node.body, prefix)
                visit(node.orelse, prefix)
                for h in getattr(node, "handlers", ()):
                    visit(h.body, prefix)
    visit(tree.body)
    return out


def _parse(path):
    with open(path, encoding="utf-8") as f:
        return ast.parse(f.read(), filename=path)


JAX_TESTS = {f"{name}.py::{key}": node for name in JAX_FILES
             for key, node in _tests_of(
                 _parse(os.path.join(ROOT, name + ".py"))).items()}
PORT_TESTS = {f"{os.path.basename(p)}::{key}"
              for p in sorted(glob.glob(os.path.join(ROOT,
                                                     "test_torch_*.py")))
              for key in _tests_of(_parse(p))}


def test_every_jax_test_has_an_entry():
    assert len(JAX_TESTS) > 200
    missing = sorted(set(JAX_TESTS) - set(MAP))
    stale = sorted(set(MAP) - set(JAX_TESTS))
    assert not missing, f"JAX tests without an audit entry: {missing}"
    assert not stale, f"audit entries for no JAX test: {stale}"


def test_every_named_port_test_exists():
    named = {t for v in MAP.values() if not isinstance(v, str) for t in v}
    assert named and not sorted(named - PORT_TESTS), \
        sorted(named - PORT_TESTS)
    for key, value in MAP.items():
        if not isinstance(value, str):
            assert value and len(value) == len(set(value)), key


def _is_placeholder(node):
    body = [s for s in node.body
            if not (isinstance(s, ast.Expr)
                    and isinstance(s.value, ast.Constant))]
    return all(isinstance(s, ast.Pass) for s in body)


@pytest.mark.parametrize("key", sorted(k for k, v in MAP.items()
                                       if isinstance(v, str)))
def test_reasons_stand_only_for_placeholders(key):
    assert MAP[key].startswith(REASON), key
    assert _is_placeholder(JAX_TESTS[key]), \
        f"{key} checks something: name the port tests that hold it"


def test_a_port_test_of_the_same_name_is_named():
    """A port test that carries a JAX test's own name is its counterpart:
    the JAX test's entry must name it."""
    by_name = {}
    for t in PORT_TESTS:
        by_name.setdefault(t.split("::")[-1], set()).add(t)
    for key, value in MAP.items():
        same = by_name.get(key.split("::")[-1], set())
        if same and not isinstance(value, str):
            assert same & set(value), (key, sorted(same))
