"""The port's entry-point scripts: one module per script of the JAX
package's ``examples/``, with its flags, defaults, synthetic data and
printed lines, plus ``--device`` (the card unless ``--device cpu``).

    python -m fp8tpu_torch.examples.train_fp8 --opt8 --emb-fmt e4m3
    python -m fp8tpu_torch.examples.serve_llm --paged --prefix-cache
    python -m fp8tpu_torch.examples.serve_http
    python -m fp8tpu_torch.examples.eval_ppl --train 200
    python -m fp8tpu_torch.examples.resnet_ptq --model resnet50
    python -m fp8tpu_torch.examples.resnet_qat --epochs 1
    python -m fp8tpu_torch.examples.launch_sweep --models tiny_vit
    python -m fp8tpu_torch.examples.bert_squad_ptq
    python -m fp8tpu_torch.examples.bert_qa_finetune --steps 5

Each module's ``main(argv=None, variables=None) -> dict`` returns what it
prints.  ``variables`` is a Flax-layout tree of numpy arrays (the JAX
script's own initial weights), carried in through
``models.variables_from_flax``; the command line never sets it.
"""
